"""advmix_tpu_torch — the PyTorch/CUDA port of advmix_tpu.

A second package beside the JAX package `advmix_tpu`, which stays the
reference every module here is tested against. Subpackages mirror the JAX
package's names so each module's counterpart is easy to find. The port
imports neither `jax` nor `advmix_tpu`. Its entry points run on the CUDA
device unless the caller asks for the CPU (`device="cpu"`), and the three
Pallas kernels of the JAX package are hand-written CUDA C++ kernels here
(`csrc/`, wrapped in `ops/cuda/`).
"""

__version__ = "0.1.0"
