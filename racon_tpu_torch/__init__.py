"""racon_tpu_torch: the PyTorch + CUDA port of racon_tpu for NVIDIA Hopper.

The default polish path (Myers overlap alignment, scored banded-NW with
the RLE walk inside iterative star-POA) runs through four hand-written
CUDA kernels (kernels/csrc) built at first use. The jax-free host code of
racon_tpu (io, core, native, models, utils) is shared, not copied; this
package never imports jax.
"""

from racon_tpu import RACON_VERSION  # noqa: F401

__version__ = "0.1.0"
